"""The port's small names against the JAX package's: `config.TrainConfig`
(field names, types and defaults), the path constants with
`RESULTS_DIR` and `NOTEBOOKS_DIR` and their `ARTGRAPH_*` overrides (read
at each package's first import, so checked in a fresh interpreter), and
`models.vit_base_patch16_224` (ViT-B/16: the JAX trunk's parameter count,
from `jax.eval_shape`, and the dtype passed through).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artgraph_tpu import config as jax_config
from artgraph_tpu.models import vit_base_patch16_224 as jax_vit_b16
from artgraph_tpu_torch import config
from artgraph_tpu_torch.models import vit_base_patch16_224

PATHS = ("IMAGE_DIR", "DATASET_DIR", "EMBEDDINGS_DIR", "PROJECTIONS_DIR",
         "CHECKPOINTS_DIR", "RESULTS_DIR", "NOTEBOOKS_DIR")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_train_config_matches_jax():
    ours = dataclasses.fields(config.TrainConfig)
    ref = dataclasses.fields(jax_config.TrainConfig)
    assert [(f.name, f.type, f.default) for f in ours] == \
        [(f.name, f.type, f.default) for f in ref]
    cfg = config.TrainConfig(epochs=3, lr=1e-3)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_config.TrainConfig(epochs=3, lr=1e-3))
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.epochs = 4


@pytest.mark.parametrize("name", PATHS)
def test_path_constants_match_jax(name):
    assert getattr(config, name) == getattr(jax_config, name)


def test_path_overrides_match_jax(tmp_path):
    env = dict(os.environ, ARTGRAPH_RESULTS_DIR=str(tmp_path / "res"),
               ARTGRAPH_NOTEBOOKS_DIR=str(tmp_path / "nb"),
               ARTGRAPH_DATASET_DIR=str(tmp_path / "ds"))
    code = ("import json; from artgraph_tpu_torch import config as a; "
            "from artgraph_tpu import config as b; "
            f"n = {list(PATHS)!r}; "
            "print(json.dumps([[getattr(a, k) for k in n], "
            "[getattr(b, k) for k in n], a.TrainConfig().dataset_path]))")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    ours, ref, dataset_path = json.loads(out.stdout.strip().splitlines()[-1])
    assert ours == ref
    assert ours[PATHS.index("RESULTS_DIR")] == str(tmp_path / "res")
    assert ours[PATHS.index("NOTEBOOKS_DIR")] == str(tmp_path / "nb")
    assert dataset_path == str(tmp_path / "ds")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_vit_base_patch16_224_matches_jax(dtype):
    vit = vit_base_patch16_224(dtype)
    ref = jax_vit_b16(jnp.bfloat16 if dtype == torch.bfloat16
                      else jnp.float32)
    assert vit.dtype == dtype and len(vit.blocks) == ref.depth == 12
    assert vit.embed_dim == ref.embed_dim == 768
    assert vit.patch_embed.proj.stride == (ref.patch_size,) * 2
    assert vit.blocks[0].attn.num_heads == ref.num_heads == 12
    assert vit.blocks[0].mlp.fc1.out_features == 4 * 768
    shapes = jax.eval_shape(
        lambda: ref.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 224, 224, 3), jnp.float32)))
    n_ref = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in vit.parameters()) == n_ref
