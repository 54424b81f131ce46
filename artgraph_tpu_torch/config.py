"""Path configuration and experiment constants of the port.

A copy of the constants the port needs from artgraph_tpu/config.py (the
reference's src/config.py paths plus the per-script literals), kept here so
that nothing of the port imports the JAX package. The path constants take
the same `ARTGRAPH_*` environment overrides, read when this module is first
imported. The CLIs read the path constants when they run, not as default
arguments bound at import, so a caller (or a test) may point them elsewhere
by setting the module attributes.
"""
from __future__ import annotations

import dataclasses
import os

# --- Path constants (ref: src/config.py:1-7). Same defaults, env-overridable.
IMAGE_DIR = os.environ.get("ARTGRAPH_IMAGE_DIR", "../../images/imagesf2")
DATASET_DIR = os.environ.get("ARTGRAPH_DATASET_DIR", "../dataset")
EMBEDDINGS_DIR = os.environ.get(
    "ARTGRAPH_EMBEDDINGS_DIR", os.path.join(DATASET_DIR, "train", "embeddings")
)
PROJECTIONS_DIR = os.environ.get("ARTGRAPH_PROJECTIONS_DIR", "../proj")
CHECKPOINTS_DIR = os.environ.get("ARTGRAPH_CHECKPOINTS_DIR", "../checkpoints")
RESULTS_DIR = os.environ.get("ARTGRAPH_RESULTS_DIR", "../results")
NOTEBOOKS_DIR = os.environ.get("ARTGRAPH_NOTEBOOKS_DIR", "../notebooks")

# --- Task constants (ref: train_baseline.py:27-30 et al.).
NUM_CLASSES = {"genre": 18, "style": 32}

# Embedding width of the GNN stage, consumed by every fusion model
# (ref: train_gnn_embeddings.py:131 hidden_channels=128).
EMB_SIZE = 128

# Image geometry (ref: src/data/data.py:14 Resize((224,224))).
IMAGE_SIZE = 224
# The transforms that decode at another size: Swin-B at 384 px (timm's
# swin_base_patch4_window12_384), which the reference does not train.
IMAGE_SIZES = {"swin": 384}

# Per-architecture normalization statistics
# (ref: src/data/data.py:11-27 transform / vit_transform; swin: timm's
# ImageNet mean and std for swin_base_patch4_window12_384).
NORM_STATS = {
    "resnet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "vit": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    "swin": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
}


def image_size(transform_type: str) -> int:
    """The side images of a transform are decoded at (IMAGE_SIZES, read
    when called, else IMAGE_SIZE)."""
    return IMAGE_SIZES.get(transform_type, IMAGE_SIZE)

# Global seed of every reference trainer (ref: train_baseline.py:10
# torch.manual_seed(1)).
GLOBAL_SEED = 1

# Projector split seed (ref: src/utils.py:215-221 random_state=11).
PROJECTION_SPLIT_SEED = 11


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Typed bundle of the shared CLI hyperparameters, the JAX package's
    (artgraph_tpu/config.py): the reference's shared argparse names
    (ref: src/utils.py:17-28), then that package's additions (`bf16` is
    the compute policy, `data_axis` the mesh axis name, `num_workers` the
    loader's threads, `prefetch` the batches copied ahead). The defaults
    are the paths above as this module was first imported."""

    image_path: str = IMAGE_DIR
    dataset_path: str = DATASET_DIR
    exp: str = "test"
    epochs: int = 1
    batch: int = 32
    lr: float = 3e-4
    with_weights: bool = False
    tracking: bool = False

    seed: int = GLOBAL_SEED
    bf16: bool = True
    data_axis: str = "data"
    num_workers: int = 6
    prefetch: int = 2
