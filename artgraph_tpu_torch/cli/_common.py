"""Shared CLI plumbing of the port: the reference's base argparse surface,
the --device, the single- and multi-task losses, the context trainers'
joint loss, checkpoints, the epoch loop and the test evaluation.

Port of the part of artgraph_tpu/cli/_common.py that the image, context,
projector and fusion trainers need.
Flag names, defaults, checkpoint naming, print formats and the results CSVs
are the reference's. Added: `--device` (default `cuda`, as `predict`), and
the JAX CLIs' `--image_cache` (data/cache.py), `--resident_data`
(data/resident.py) and `--no_epoch_scan` (the resident loader's per-batch
stream instead of its epoch matrices), on `cuda` and on the CPU alike.
Refused, because they need modules the port does not have yet (ROADMAP.md
§1): the JAX CLIs' `--resume` and `--init_checkpoint` (checkpoint and
warm-start plumbing), `--data_parallel` (the data mesh) and `-t/--tracking`
(MLflow); the port's parser does not accept them.
"""
from __future__ import annotations

import argparse
import os
import warnings
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from artgraph_tpu_torch import config
from artgraph_tpu_torch.checkpointing import save_reference_checkpoint
from artgraph_tpu_torch.data.cache import wrap_with_cache
from artgraph_tpu_torch.data.loader import DataLoader, prepare_dataloader
from artgraph_tpu_torch.data.resident import (ResidentCapacityError,
                                              ResidentLoader)
from artgraph_tpu_torch.metrics import summarize, write_results
from artgraph_tpu_torch.train import cross_entropy
from artgraph_tpu_torch.train.trainer import Trainer, accuracy_metrics


def get_base_arguments() -> argparse.ArgumentParser:
    """Shared argparse surface (ref: src/utils.py:17-28) plus --num_workers,
    --results_dir and --device."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--image_path', type=str, default=config.IMAGE_DIR,
                        help='Experiment name.')
    parser.add_argument('--dataset_path', type=str, default=config.DATASET_DIR,
                        help='Experiment name.')
    parser.add_argument('--exp', type=str, default='test', help='Experiment name.')
    parser.add_argument('--epochs', type=int, default=1,
                        help='Number of epochs to train.')
    parser.add_argument('--batch', type=int, default=32,
                        help='Number of epochs to train.')
    parser.add_argument('--lr', type=float, default=3e-4,
                        help='Initial learning rate.')
    parser.add_argument('--with_weights', action='store_true',
                        help='If using class weights for tackling class imabalnces.')
    parser.add_argument('--num_workers', type=int, default=6,
                        help='Host data-loader worker threads.')
    parser.add_argument('--results_dir', type=str, default=None,
                        help='If set, emit reference-schema results CSVs here.')
    parser.add_argument('--device', type=str, default='cuda',
                        help='Torch device to train on (cuda, cuda:N or cpu).')
    parser.add_argument('--image_cache', type=str, default=None,
                        help='Directory for the decoded-uint8 image cache '
                             '(first epoch decodes once; later epochs read '
                             'at memory bandwidth).')
    parser.add_argument('--resident_data', action='store_true',
                        help='Keep the decoded dataset resident in device '
                             'memory and gather batches on device (zero bulk '
                             'H2D per step). Needs the uint8 dataset + '
                             'embeddings to fit in device memory '
                             '(~150KB/image).')
    parser.add_argument('--no_epoch_scan', action='store_true',
                        help='With --resident_data, keep per-batch step '
                             'dispatch instead of running the epoch from '
                             'its uploaded index and mask matrices.')
    return parser


def resolve_device(name: str) -> torch.device:
    """The --device of a CLI as a torch.device; cuda without a card raises,
    never falls back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: CUDA is not available "
                               f"(pass --device cpu to use the CPU)")
        if device.index is not None:
            torch.cuda.set_device(device)   # the kernels launch on this device
    return device


def make_loaders(datasets: Dict, batch_size: int, num_workers: int,
                 seed: int = config.GLOBAL_SEED, cache_dir: str = None,
                 resident: bool = False, epoch_scan: bool = True,
                 device: str | torch.device = "cuda"):
    """Reference loader kwargs (ref: train_baseline.py:23-25): shuffled,
    no drop_last; the last batch padded with a mask.

    `cache_dir` routes every split's images through the decoded cache.
    `resident=True` keeps each split on `device` (data/resident.py); a
    split that exceeds the device-memory budget WARNS and keeps the host
    DataLoader, as the JAX package's capacity rule does: its batches still
    train on the device."""
    if cache_dir:
        datasets = {name: wrap_with_cache(ds, cache_dir, name)
                    for name, ds in datasets.items()}
    host_kwargs = dict(batch_size=batch_size, shuffle=True, drop_last=False,
                       num_workers=num_workers, seed=seed)
    if not resident:
        return prepare_dataloader(datasets, **host_kwargs)
    loaders = {}
    for name, ds in datasets.items():
        try:
            loaders[name] = ResidentLoader(
                ds, batch_size=batch_size, shuffle=True, drop_last=False,
                seed=seed, epoch_scan=epoch_scan, device=device)
        except ResidentCapacityError as e:
            warnings.warn(f"--resident_data: split {name!r} exceeds the "
                          f"device memory budget ({e}); using the host "
                          f"loader")
            loaders[name] = DataLoader(ds, **host_kwargs)
    return loaders


def single_task_loss(class_weights: Optional[np.ndarray],
                     device: str | torch.device = "cpu"):
    """compute_loss for a single-task head: weighted masked cross-entropy and
    the masked correct count; the class weights live on `device`."""
    cw = _on_device(class_weights, device)

    def compute(outputs, batch):
        labels, mask = batch[-2], batch[-1]
        loss = cross_entropy(outputs, labels, class_weights=cw, mask=mask)
        return loss, accuracy_metrics(outputs, labels, mask)

    return compute


def multi_task_loss(weights_style: Optional[np.ndarray],
                    weights_genre: Optional[np.ndarray], w_style: float,
                    w_genre: float, device: str | torch.device = "cpu"):
    """w_style * CE_style + w_genre * CE_genre over outputs [style, genre]
    and labels [B, 2] (0.5/0.5 in the fusion trainer, ref:
    train_new_multimodal_multitask.py:79-81); metrics style_correct and
    genre_correct."""
    cw_s = _on_device(weights_style, device)
    cw_g = _on_device(weights_genre, device)

    def compute(outputs, batch):
        labels, mask = batch[-2], batch[-1]
        style_labels, genre_labels = labels[:, 0], labels[:, 1]
        loss = (w_style * cross_entropy(outputs[0], style_labels, cw_s, mask)
                + w_genre * cross_entropy(outputs[1], genre_labels, cw_g,
                                          mask))
        metrics = accuracy_metrics(outputs[0], style_labels, mask, "style_")
        metrics.update(accuracy_metrics(outputs[1], genre_labels, mask,
                                        "genre_"))
        return loss, metrics

    return compute


def joint_loss(class_loss, encoder_criterion, lamb: float):
    """The ContextNet / MultiModal train loss over (images, embeddings,
    labels, mask) batches and (logits, graph_proj) outputs:
    lamb * class_loss + (1 - lamb) * encoder_criterion(graph_proj,
    embeddings) over the valid rows (ref: train_baseline_context.py:75-81);
    the metrics are class_loss's."""

    def compute(outputs, batch):
        out, graph_proj = outputs
        class_value, metrics = class_loss(out, batch)
        encoder_value = encoder_criterion(graph_proj, batch[1],
                                          mask=batch[-1])
        return lamb * class_value + (1 - lamb) * encoder_value, metrics

    return compute


def logits_loss(class_loss):
    """The context trainers' eval loss: class_loss on the logits of
    (logits, graph_proj), over image-only (images, labels, mask) batches
    (ref: train_baseline_context.py:98-105)."""
    return lambda outputs, batch: class_loss(outputs[0], batch)


def _on_device(class_weights: Optional[np.ndarray],
               device: str | torch.device) -> Optional[torch.Tensor]:
    if class_weights is None:
        return None
    return torch.as_tensor(np.asarray(class_weights, np.float32)).to(device)


def save_checkpoint(model: torch.nn.Module, path: str) -> None:
    """EarlyStopping's save_fn: the model as a reference .pt."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    save_reference_checkpoint(model, path)


def reload_state(trainer: Trainer, path: str) -> None:
    """Load the best checkpoint back into the trainer's model (strict)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    trainer.model.load_state_dict(sd, strict=True)


def run_epoch_loop(args, train_fn, valid_fn) -> None:
    """The reference epoch loop: all --epochs run, train_fn() then
    valid_fn(); early stopping only selects the saved checkpoint (ref:
    train_baseline.py:133-137). The JAX loop's other arguments (trainer,
    state, loaders, early stopping, the epoch) serve its --resume and
    --tracking branches, which the port does not have."""
    for _ in range(args.epochs):
        train_fn()
        valid_fn()


def evaluate_single_task(trainer: Trainer, loader, num_classes: int,
                         results_dir: Optional[str] = None,
                         output_index: Union[int, Tuple[int, ...],
                                             None] = None,
                         suffix: str = "") -> float:
    """Test-split accuracy of one task; with results_dir also the reference
    CSVs, `results{suffix}.csv` etc. output_index picks the task's logits
    out of the model's outputs: an index, or a path of indices into nested
    ones ((0, 1): the genre logits of ([style, genre], graph_proj)); suffix
    ('_style' or '_genre') picks the column of [n, 2] labels."""
    _, collected = trainer.eval_epoch(loader, collect_outputs=True)
    task_col = {"_style": 0, "_genre": 1}.get(suffix)
    path = () if output_index is None else (
        output_index if isinstance(output_index, tuple) else (output_index,))
    logits, labels = [], []
    for out, rest in collected:
        for i in path:
            out = out[i]
        logits.append(out)
        lab = rest[-1]   # labels are the last non-mask batch component
        if lab.ndim == 2:
            if task_col is None:
                raise ValueError(
                    f"multitask labels need suffix '_style' or '_genre' to "
                    f"select a column (got suffix={suffix!r})")
            lab = lab[:, task_col]
        labels.append(lab)
    summary = summarize(np.concatenate(labels), np.concatenate(logits),
                        num_classes)
    if results_dir:
        write_results(results_dir, summary, suffix=suffix)
    return summary["accuracy"]
