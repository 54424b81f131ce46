"""Epoch-scale decision parity of the port against the JAX package under
their production policies (slow tier): the port's counterpart of
tests/test_epoch_parity.py, with its schedule, sizes and bounds.

As there, a shared f32 warm-up in the JAX package (WARMUP_EPOCHS = 10 of
Adam(1e-3), batch schedule seed 11, from the torch oracle's ResNet50 init
under seed 0) makes one semi-converged state: the fine-tuning regime the
reference trains in. From it both packages train PHASE2_EPOCHS = 8 epochs
under their production policies, with fresh Adam(1e-4), dropout 0 and the
same batch schedule (seed 12): the JAX package as that file does it (bf16
compute, its MixedBatchNorm, the fused uint8 normalize, a jitted step),
the port through its Trainer (bf16 compute, its MixedBatchNorm, the
normalize's plain version on the CPU), its weights carried over from the
warm state by `state_dict_from_flax`. Then each predicts the 8 test images
in eval mode.

Bounds, the JAX file's (test_epoch_parity.py:72-73): |test-accuracy gap|
<= 0.125 (one image), argmax agreement >= 0.75, and both accuracies >= 0.75
(3x chance), so two equally broken runs cannot pass.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artgraph_tpu import models as jax_models
from artgraph_tpu.checkpointing.torch_interop import (export_model_state,
                                                      import_model_state)
from artgraph_tpu.ops.preprocess import normalize_images as jax_normalize
from artgraph_tpu_torch.checkpointing import state_dict_from_flax
from artgraph_tpu_torch.cli._common import single_task_loss
from artgraph_tpu_torch.models import ResnetSingleTask
from artgraph_tpu_torch.ops import normalize_images
from artgraph_tpu_torch.train import Trainer, adam
from test_epoch_parity import (ACC_FLOOR, ACC_GAP_TOL, AGREEMENT_FLOOR,
                               LR_FT, N_CLASS, PHASE2_EPOCHS, WARMUP_EPOCHS,
                               _jax_train, _schedule, _split_arrays)
from _torch_oracles import ResNet50Oracle

pytestmark = pytest.mark.slow

torch.set_num_threads(4)


def _oracle_init() -> dict:
    """test_epoch_parity.run_parity's init: the oracle ResNet50 under seed
    0 and a Dropout(0) -> Linear head, in the reference's keys."""
    torch.manual_seed(0)
    o = ResNet50Oracle()
    model = torch.nn.ModuleDict({
        "resnet": torch.nn.Sequential(o.conv1, o.bn1, o.relu, o.maxpool,
                                      o.layer1, o.layer2, o.layer3, o.layer4,
                                      o.avgpool),
        "classifier": torch.nn.Sequential(torch.nn.Dropout(0.0),
                                          torch.nn.Linear(2048, N_CLASS))})
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def _port_phase2(warm: dict, imgs, y, schedule, test_imgs):
    model = ResnetSingleTask(N_CLASS, 0.0)             # bf16 compute
    model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in
         state_dict_from_flax("ResnetSingleTask", warm).items()},
        strict=True)
    trainer = Trainer(model, adam(LR_FT), compute_loss=single_task_loss(None),
                      transform_type="resnet", device="cpu")
    for epoch in schedule:
        trainer.train_epoch([(imgs[idx], y[idx].astype(np.int32),
                              np.ones(len(idx), np.float32))
                             for idx in epoch])
    model.eval()
    with torch.no_grad():
        logits = model(normalize_images(torch.from_numpy(test_imgs),
                                        "resnet"))
    return logits.float().numpy().argmax(-1)


def test_epoch_scale_production_policy_parity(synthetic_dataset):
    ds, img = synthetic_dataset["dataset_dir"], synthetic_dataset["image_dir"]
    train_imgs, train_y = _split_arrays(ds, img, "train")
    test_imgs, test_y = _split_arrays(ds, img, "test")
    n = len(train_y)

    # the shared f32 warm-up in the JAX package
    warm = _jax_train(
        jax_models.ResnetSingleTask(num_class=N_CLASS, dropout=0.0,
                                    dtype=jnp.float32),
        import_model_state("ResnetSingleTask", _oracle_init()),
        train_imgs, train_y, _schedule(n, WARMUP_EPOCHS, seed=11))
    phase2 = _schedule(n, PHASE2_EPOCHS, seed=12)

    # the JAX package's production phase, as test_epoch_parity runs it
    jmodel = jax_models.ResnetSingleTask(num_class=N_CLASS, dropout=0.0)
    final = _jax_train(jmodel, warm, train_imgs, train_y, phase2, lr=LR_FT)
    j_logits = jax.jit(lambda v, u8: jmodel.apply(
        v, jax_normalize(u8, "resnet"), train=False))(
            final, jnp.asarray(test_imgs))
    j_pred = np.asarray(j_logits, np.float32).argmax(-1)

    p_pred = _port_phase2(warm, train_imgs, train_y, phase2, test_imgs)
    j_acc = float((j_pred == test_y).mean())
    p_acc = float((p_pred == test_y).mean())
    agreement = float((p_pred == j_pred).mean())
    print(f"epoch parity: port acc {p_acc}, JAX acc {j_acc}, agreement "
          f"{agreement}; port {p_pred.tolist()}, JAX {j_pred.tolist()}, "
          f"labels {test_y.tolist()}")
    assert abs(p_acc - j_acc) <= ACC_GAP_TOL
    assert agreement >= AGREEMENT_FLOOR
    assert p_acc >= ACC_FLOOR and j_acc >= ACC_FLOOR
