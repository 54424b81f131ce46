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

import os

# --- Path constants (ref: src/config.py:1-7). Same defaults, env-overridable.
IMAGE_DIR = os.environ.get("ARTGRAPH_IMAGE_DIR", "../../images/imagesf2")
DATASET_DIR = os.environ.get("ARTGRAPH_DATASET_DIR", "../dataset")
EMBEDDINGS_DIR = os.environ.get(
    "ARTGRAPH_EMBEDDINGS_DIR", os.path.join(DATASET_DIR, "train", "embeddings")
)
PROJECTIONS_DIR = os.environ.get("ARTGRAPH_PROJECTIONS_DIR", "../proj")
CHECKPOINTS_DIR = os.environ.get("ARTGRAPH_CHECKPOINTS_DIR", "../checkpoints")

# --- Task constants (ref: train_baseline.py:27-30 et al.).
NUM_CLASSES = {"genre": 18, "style": 32}

# Embedding width of the GNN stage, consumed by every fusion model
# (ref: train_gnn_embeddings.py:131 hidden_channels=128).
EMB_SIZE = 128

# Image geometry (ref: src/data/data.py:14 Resize((224,224))).
IMAGE_SIZE = 224

# Per-architecture normalization statistics
# (ref: src/data/data.py:11-27 transform / vit_transform).
NORM_STATS = {
    "resnet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "vit": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
}

# Global seed of every reference trainer (ref: train_baseline.py:10
# torch.manual_seed(1)).
GLOBAL_SEED = 1

# Projector split seed (ref: src/utils.py:215-221 random_state=11).
PROJECTION_SPLIT_SEED = 11
