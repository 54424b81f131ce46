"""Dataset factories and class weights for the image trainers and the
fusion pipeline.

Port of artgraph_tpu/data/factories.py: load_dataset,
load_dataset_multimodal, load_dataset_new_multimodal,
load_dataset_multitask_new_multimodal, load_dataset_projection and
get_class_weights (ref: src/utils.py:51-223, 268-274). The projector's seeded 80/10/10 split is
scikit-learn's `train_test_split(..., random_state=11)` restated with numpy
(`split_indices`), since the GPU host has no scikit-learn.
"""
from __future__ import annotations

import math
import os
from typing import Dict

import numpy as np

from artgraph_tpu_torch import config
from artgraph_tpu_torch.data.datasets import (ArtGraphMultiTask,
                                              ArtGraphSingleTask,
                                              LabelProjectionDataset,
                                              MultiModalArtgraphMultiTask,
                                              MultiModalArtgraphSingleTask,
                                              NewMultiModalArtgraphMultiTask,
                                              Subset)
from artgraph_tpu_torch.data.embeddings import load_embedding
from artgraph_tpu_torch.data.manifest import prepare_raw_dataset

SPLITS = ("train", "validation", "test")


def _image_only(mode: str, label: str | None):
    """(dataset class, manifest columns) of an image-only split."""
    if mode == "single_task":
        if label not in ("style", "genre"):
            raise ValueError(f"unknown label {label!r}")
        return ArtGraphSingleTask, ["image", label]
    if mode == "multi_task":
        return ArtGraphMultiTask, ["image", "style", "genre"]
    raise ValueError(f"unknown mode {mode!r} (single_task|multi_task)")


def load_dataset(base_dir: str, image_dir: str, mode: str, label: str = None,
                 transform_type: str = "resnet"):
    """(train, valid, test) image datasets: one label's (single_task) or
    both labels' [B, 2] (multi_task), ref: src/utils.py:51-81."""
    cls, cols = _image_only(mode, label)
    return tuple(
        cls(image_dir, prepare_raw_dataset(base_dir, type=split)[cols],
            transform_type)
        for split in SPLITS)


def load_dataset_multimodal(base_dir: str, image_dir: str, mode: str,
                            label: str = None, emb_type: str = None,
                            emb_train: str = None):
    """The ContextNet / MultiModal datasets (ref: src/utils.py:83-118): the
    train split gives (image, embedding, label(s)) from
    <base>/train/embeddings/<emb_train>; valid and test are image-only,
    since the logits need no embedding. All three use the ResNet
    transform."""
    if emb_type not in ("artwork", "genre", "style"):
        raise ValueError(f"unknown emb_type {emb_type!r}")
    cls, cols = _image_only(mode, label)
    raw = {split: prepare_raw_dataset(base_dir, type=split)[cols]
           for split in SPLITS}
    embeddings = _split_embedding(base_dir, "train", emb_train)
    train = (MultiModalArtgraphSingleTask(image_dir, raw["train"], embeddings,
                                          emb_type=emb_type)
             if mode == "single_task"
             else MultiModalArtgraphMultiTask(image_dir, raw["train"],
                                              embeddings))
    return (train, cls(image_dir, raw["validation"]),
            cls(image_dir, raw["test"]))


def _split_embedding(base_dir: str, split: str, name: str) -> np.ndarray:
    return load_embedding(os.path.join(base_dir, split, "embeddings", name))


def load_dataset_new_multimodal(base_dir: str, image_dir: str, label: str,
                                emb_type: str, emb_train: str, emb_valid: str,
                                emb_test: str):
    """Single-task fusion datasets (ref: src/utils.py:120-153): train gets
    the TRUE embeddings, valid/test the PROJECTED ones."""
    names = dict(zip(SPLITS, (emb_train, emb_valid, emb_test)))
    return tuple(
        MultiModalArtgraphSingleTask(
            image_dir, prepare_raw_dataset(base_dir, type=split)[
                ["image", label]],
            _split_embedding(base_dir, split, names[split]), type=split,
            emb_type=emb_type)
        for split in SPLITS)


def load_dataset_multitask_new_multimodal(base_dir: str, image_dir: str,
                                          emb_type: str,
                                          emb_train: Dict[str, str],
                                          emb_valid: Dict[str, str],
                                          emb_test: Dict[str, str],
                                          transform_type: str = "resnet"):
    """Multi-task fusion datasets (ref: src/utils.py:155-192); the eval
    datasets' type is 'valid' / 'test', as the JAX package passes."""
    names = dict(zip(SPLITS, (emb_train, emb_valid, emb_test)))
    kinds = dict(zip(SPLITS, ("train", "valid", "test")))
    return tuple(
        NewMultiModalArtgraphMultiTask(
            image_dir, prepare_raw_dataset(base_dir, type=split)[
                ["image", "style", "genre"]],
            _split_embedding(base_dir, split, names[split]["style"]),
            _split_embedding(base_dir, split, names[split]["genre"]),
            kinds[split], emb_type, transform_type)
        for split in SPLITS)


def split_indices(n: int, test_size: float, seed: int):
    """scikit-learn's `train_test_split(list(range(n)), test_size=test_size,
    random_state=seed)` without scikit-learn: (train, test) index arrays.
    ShuffleSplit draws one RandomState(seed) permutation; the test side is
    its first ceil(test_size * n) entries, the train side the rest."""
    perm = np.random.RandomState(seed).permutation(n)
    n_test = math.ceil(test_size * n)
    return perm[n_test:], perm[:n_test]


def load_dataset_projection(base_dir: str, image_dir: str,
                            node_embedding: str, emb_type: str):
    """Projector train/valid/test: a seeded 80/10/10 split of the TRAIN
    set (ref: src/utils.py:194-223, random_state=11; it defines which rows
    the published projector checkpoints were trained on). The embedding
    table is read from config.EMBEDDINGS_DIR, as the JAX package reads it."""
    raw = prepare_raw_dataset(base_dir, type="train")
    embeddings = load_embedding(os.path.join(config.EMBEDDINGS_DIR,
                                             node_embedding))
    dataset = LabelProjectionDataset(
        image_dir, raw[["image", "style", "genre"]], embeddings, emb_type)
    seed = config.PROJECTION_SPLIT_SEED
    train_idx, drop_idx = split_indices(len(dataset), 0.2, seed)
    dataset_drop = Subset(dataset, drop_idx)
    valid_idx, test_idx = split_indices(len(dataset_drop), 0.5, seed)
    return (Subset(dataset, train_idx), Subset(dataset_drop, valid_idx),
            Subset(dataset_drop, test_idx))


def get_class_weights(dataset_train, num_classes: int, label: str
                      ) -> np.ndarray:
    """Balanced class weights n / (count * num_classes), in sorted label
    order (pandas groupby), as the reference feeds CrossEntropyLoss."""
    dataset = dataset_train.dataset
    class_distribution = dataset.groupby(label).count()
    n_artworks = class_distribution.image.sum()
    weights = class_distribution["image"].map(
        lambda x: n_artworks / (x * num_classes))
    return np.asarray(weights.tolist(), dtype=np.float32)
