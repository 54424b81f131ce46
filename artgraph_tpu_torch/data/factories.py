"""Dataset factory and class weights for the single-task image trainers.

Port of artgraph_tpu/data/factories.py:load_dataset (single-task mode) and
get_class_weights (ref: src/utils.py:51-81, 268-274). Neither needs
scikit-learn, which the GPU host does not have; the projector's seeded split
(the one user of scikit-learn) is not ported yet.
"""
from __future__ import annotations

import numpy as np

from artgraph_tpu_torch.data.datasets import ArtGraphSingleTask
from artgraph_tpu_torch.data.manifest import prepare_raw_dataset


def load_dataset(base_dir: str, image_dir: str, mode: str, label: str = None,
                 transform_type: str = "resnet"):
    """(train, valid, test) image datasets for one label."""
    if mode != "single_task":
        raise NotImplementedError(
            f"load_dataset(mode={mode!r}): the port has the single-task mode "
            f"only; the multitask trainers are queued in ROADMAP.md §1")
    if label not in ("style", "genre"):
        raise ValueError(f"unknown label {label!r}")
    return tuple(
        ArtGraphSingleTask(image_dir,
                           prepare_raw_dataset(base_dir, type=split)[
                               ["image", label]], transform_type)
        for split in ("train", "validation", "test"))


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
