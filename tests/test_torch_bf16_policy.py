"""The port's production dtype policy against f32 over ten Adam steps (slow
tier): the port's counterpart of tests/test_bf16_policy.py, with its sizes,
data and bounds.

The port's Trainer runs 10 Adam(3e-4) steps (one-batch `train_epoch`s, so
each epoch's loss is the step's) of the same model twice on the CPU, in
bf16 (the production policy: bf16 compute, f32 parameters, BatchNorm
statistics, logits and loss) and in f32, from one init (torch's under seed
0, loaded into both) and on the same batches: 224 px uint8 noise images
with random labels over 4 classes, seed 42 (losses then stay O(1), so the
relative drift measures the policy). Dropout 0.4 draws the same masks in
both runs (one seed, the same shapes). ResnetSingleTask(4, 0.4) at batch 8,
ViTSingleTask(4, 0.4) at batch 4, both normalized as the JAX file's `_run`
normalizes them (transform "resnet").

Bounds, the JAX file's (test_bf16_policy.py:22-23): every step's loss
within 0.2 relative (|bf16 - f32| / max(f32, 1)) and the final parameters
within relative L2 0.1; a policy regression (bf16 BatchNorm statistics, a
bf16 loss reduction, parameters cast to bf16) moves them by O(1). Both
packages' drifts are printed (`-s`): the JAX package's from its own
`_run` on the same batches.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from artgraph_tpu import models as jax_models
from artgraph_tpu_torch.cli._common import single_task_loss
from artgraph_tpu_torch.models import ResnetSingleTask, ViTSingleTask
from artgraph_tpu_torch.train import Trainer, adam
from test_bf16_policy import (K_STEPS, LOSS_RTOL, N_CLASS, PARAM_RTOL,
                              _batches, _rel_l2, _run as jax_run)

pytestmark = pytest.mark.slow

torch.set_num_threads(4)


def _port_run(make_model, state: dict, batches):
    model = make_model()
    model.load_state_dict(state, strict=True)
    trainer = Trainer(model, adam(3e-4), compute_loss=single_task_loss(None),
                      transform_type="resnet", device="cpu", seed=1)
    losses = [trainer.train_epoch([b])["loss"] for b in batches]
    return np.asarray(losses), {k: p.detach().double().numpy()
                                for k, p in model.named_parameters()}


def _drift(losses_bf16, losses_f32, params_bf16, params_f32):
    rel = np.abs(losses_bf16 - losses_f32) / np.maximum(losses_f32, 1.0)
    num = sum(float(np.sum((params_bf16[k] - v) ** 2))
              for k, v in params_f32.items())
    den = sum(float(np.sum(v ** 2)) for v in params_f32.values())
    return rel, (num / den) ** 0.5


CASES = {
    # name -> (port model(dtype), JAX model, batch size)
    "resnet": (lambda dt: ResnetSingleTask(N_CLASS, 0.4, dtype=dt),
               "ResnetSingleTask", 8),
    "vit": (lambda dt: ViTSingleTask(N_CLASS, 0.4, dtype=dt),
            "ViTSingleTask", 4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_policy_drift(name):
    make, jax_name, batch_size = CASES[name]
    batches = _batches(batch_size)
    assert len(batches) == K_STEPS
    torch.manual_seed(0)
    state = make(torch.float32).state_dict()
    losses_bf16, params_bf16 = _port_run(lambda: make(torch.bfloat16), state,
                                         batches)
    losses_f32, params_f32 = _port_run(lambda: make(torch.float32), state,
                                       batches)
    rel, prel = _drift(losses_bf16, losses_f32, params_bf16, params_f32)

    jax_model = getattr(jax_models, jax_name)
    jl_bf16, jp_bf16 = jax_run(jax_model(N_CLASS, 0.4, dtype=jnp.bfloat16),
                               batches)
    jl_f32, jp_f32 = jax_run(jax_model(N_CLASS, 0.4, dtype=jnp.float32),
                             batches)
    jrel = np.abs(jl_bf16 - jl_f32) / np.maximum(jl_f32, 1.0)
    print(f"{name}: port max step-loss rel drift {rel.max():.4g}, params "
          f"rel-l2 {prel:.4g}; JAX {jrel.max():.4g}, "
          f"{_rel_l2(jp_bf16, jp_f32):.4g}")

    assert np.all(rel < LOSS_RTOL[name]), (rel, losses_bf16, losses_f32)
    for losses in (losses_f32, losses_bf16):
        assert np.all(np.isfinite(losses)) and np.all(losses < 10.0), losses
    assert prel < PARAM_RTOL[name], prel
