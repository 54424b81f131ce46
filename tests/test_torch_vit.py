"""The port's ViT trunk (artgraph_tpu_torch.models.vit) against the JAX ViT.

  * A tiny ViT (patch 8, embed 32, depth 2, 4 heads, mlp_ratio 2, 16x16
    images) with seeded random weights carried over by `vit_state_from_flax`,
    against JAX `ViT` with the fused Pallas kernels forced on (interpret
    mode): f32 at rtol = atol = 1e-4, bf16 at 3e-2.
  * Full ViT-B/16 width and depth in f32 against the committed golden
    `vit_flax` (tests/golden/backbones.npz) at its own tolerance
    (test_goldens.py: rtol 1e-5, atol 1e-4), with the weights rebuilt as
    tests/_make_goldens.py builds them.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artgraph_tpu.models.vit import ViT as JaxViT, force_pallas_kernels
from artgraph_tpu_torch.checkpointing import vit_state_from_flax
from artgraph_tpu_torch.models import ViT

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)

TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=4, mlp_ratio=2.0)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "backbones.npz")


def seeded_params(params, seed):
    """Every leaf replaced by seeded numpy values: LN scales near 1, kernels
    at 1/sqrt(fan_in), the rest (biases, cls token, pos embed) non-zero."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        v = rng.standard_normal(leaf.shape, dtype=np.float32)
        if name == "scale":
            return 1.0 + 0.1 * v
        if name == "kernel":
            return v * np.float32(1.0 / np.sqrt(np.prod(leaf.shape[:-1])))
        return 0.1 * v

    return jax.tree_util.tree_map_with_path(fill, params)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_tiny_vit_matches_jax_kernel_path(dtype, tol):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = np.random.default_rng(0).normal(size=(2, 16, 16, 3)).astype(np.float32)
    jax_vit = JaxViT(dtype=jdt, **TINY)
    with force_pallas_kernels():
        params = jax_vit.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        params = seeded_params(params, seed=1)
        ref = np.asarray(jax_vit.apply({"params": params}, jnp.asarray(x)),
                         np.float32)

    vit = ViT(img_size=16, dtype=tdt, **TINY).eval()
    vit.load_state_dict({k: torch.from_numpy(v) for k, v in
                         vit_state_from_flax(params, prefix="").items()},
                        strict=True)
    with torch.no_grad():
        ours = vit(torch.from_numpy(x))
    assert ours.dtype == torch.float32 and ours.shape == (2, 32)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=tol, atol=tol)


def test_vit_b16_f32_matches_golden():
    from _torch_oracles import ViTOracle

    torch.manual_seed(1)
    oracle_sd = ViTOracle(depth=12).state_dict()
    vit = ViT(dtype=torch.float32).eval()
    vit.load_state_dict({k: v for k, v in oracle_sd.items()
                         if not k.startswith("head.")}, strict=True)
    x = np.random.default_rng(1).normal(size=(2, 224, 224, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        ours = vit(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.load(GOLDEN)["vit_flax"], rtol=1e-5,
                               atol=1e-4)
