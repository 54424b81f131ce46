"""The port's kernel modules (artgraph_tpu_torch.ops) against the JAX package.

On the CPU each wrapper runs its plain PyTorch version, which shares the
CUDA kernel's rounding points; here it is held against the Pallas kernels
(interpret mode, as the JAX package's own tests run them) on the same numpy
inputs:

  * normalize: bit-exact against normalize_images (the XLA twin that the JAX
    serving step calls), and within 1 f32 ulp of normalize_images_pallas,
    whose interpret mode contracts to an FMA;
  * block attention / block MLP: f32 at rtol = atol = 1e-4 (accumulation
    order only), bf16 at 3e-2 (a bf16 ulp of the residual stream, the bound
    of tests/test_mlp_kernel.py).

tests/test_torch_cuda.py holds each CUDA kernel against its plain version
on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artgraph_tpu.ops.attention import fused_block_attention as jax_block_attn
from artgraph_tpu.ops.mlp import fused_block_mlp as jax_block_mlp
from artgraph_tpu.ops.preprocess import (normalize_images as jax_normalize,
                                         normalize_images_pallas)
from artgraph_tpu_torch.ops import (_build, attention, fused_block_attention,
                                    fused_block_mlp, mlp, normalize_images,
                                    preprocess)
from test_torch_cuda import block_inputs, torch_args

torch.set_num_threads(2)

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _compare(ours, ref, tol):
    np.testing.assert_allclose(ours.to(torch.float32).numpy(),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("transform", ["resnet", "vit"])
def test_normalize_matches_jax(transform):
    x = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3),
                                          dtype=np.uint8)
    ours = normalize_images(torch.from_numpy(x), transform).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, np.asarray(
        jax_normalize(jnp.asarray(x), transform)))
    # Pallas interpret mode contracts x*alpha+beta into an FMA on the CPU and
    # differs by 1 ulp, as tests/test_ops.py notes; same bound here.
    np.testing.assert_allclose(ours, np.asarray(
        normalize_images_pallas(jnp.asarray(x), transform)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [17, 197])
def test_block_attention_matches_pallas(N, dtype):
    B, C, H = 2, 64, 4
    x, gamma, beta, lin = block_inputs(B, N, C, ((C, 3 * C), (C, C)), seed=N)
    jdt, tdt = DTYPES[dtype]
    ref = jax_block_attn(jnp.asarray(x, jdt), *map(jnp.asarray, (gamma, beta)),
                         *map(jnp.asarray, lin), H)
    tx, params = torch_args(x, gamma, beta, lin, tdt)
    ours = fused_block_attention(tx, *params, H)
    assert ours.dtype == tdt and ours.shape == (B, N, C)
    _compare(ours, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [17, 197])
def test_block_mlp_matches_pallas(N, dtype):
    B, C, Hd = 2, 64, 128
    x, gamma, beta, lin = block_inputs(B, N, C, ((C, Hd), (Hd, C)),
                                        seed=100 + N)
    jdt, tdt = DTYPES[dtype]
    ref = jax_block_mlp(jnp.asarray(x, jdt), *map(jnp.asarray, (gamma, beta)),
                        *map(jnp.asarray, lin))
    tx, params = torch_args(x, gamma, beta, lin, tdt)
    ours = fused_block_mlp(tx, *params)
    assert ours.dtype == tdt and ours.shape == (B, N, C)
    _compare(ours, ref, TOL[dtype])


def test_cpu_calls_launch_no_kernel(monkeypatch):
    for mod in (attention, mlp, preprocess):
        monkeypatch.setattr(mod, "LAUNCHES", 0)
    x, gamma, beta, lin = block_inputs(1, 5, 64, ((64, 192), (64, 64)),
                                        seed=0)
    tx, params = torch_args(x, gamma, beta, lin, torch.bfloat16)
    fused_block_attention(tx, *params, 4)
    _, _, _, lin = block_inputs(1, 5, 64, ((64, 128), (128, 64)), seed=1)
    tx, params = torch_args(x, gamma, beta, lin, torch.bfloat16)
    fused_block_mlp(tx, *params)
    normalize_images(torch.zeros((1, 4, 4, 3), dtype=torch.uint8), "vit")
    assert (attention.LAUNCHES, mlp.LAUNCHES, preprocess.LAUNCHES) == (0, 0, 0)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit: building raises at first use, with no fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
