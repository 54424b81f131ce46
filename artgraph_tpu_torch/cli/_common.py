"""Shared CLI plumbing of the port: the reference's base argparse surface,
the --device, the single- and multi-task losses, the context trainers'
joint loss, checkpoints, warm starts, the epoch loop with its crash
recovery, and the test evaluation.

Port of artgraph_tpu/cli/_common.py.
Flag names, defaults, checkpoint naming, print formats, MLflow metric names
and the results CSVs are the reference's. Added: `--device` (default
`cuda`, as `predict`). The JAX CLIs' extras, on `cuda` and on the CPU
alike: `--image_cache` (data/cache.py), `--resident_data`
(data/resident.py), `--no_epoch_scan` (the resident loader's per-batch
stream instead of its epoch matrices), `-t/--tracking` (tracking/),
`--init_checkpoint` (`apply_init_checkpoint`), `--resume`
(`run_epoch_loop`, checkpointing/state_io.py) and `--data_parallel N`.

`--data_parallel N` (N > 0): the CLI starts N ranks of itself
(`launch_ranks`, parallel.mesh.spawn), each a process that owns `cuda:rank`
under NCCL (or the CPU under gloo with `--device cpu`), trains on its
contiguous block of `--batch / N` rows of every global batch (`make_mesh`,
`make_loaders(mesh=)`) and returns when they are done. N beyond the
visible CUDA devices, or one that does not divide `--batch`, is refused
before any rank starts (JAX's create_mesh refuses the first, its sharded
batch the second). Rank 0 alone prints, writes checkpoints, the resume
state, the results CSVs and tracking; every rank reads a resume state or a
warm start. `--data_parallel 0` (the default) is the one-process path.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from artgraph_tpu_torch import config
from artgraph_tpu_torch.checkpointing import (import_trunk_state,
                                              restore_checkpoint,
                                              save_checkpoint as save_state,
                                              save_reference_checkpoint)
from artgraph_tpu_torch.checkpointing.torch_interop import (
    jax_counterpart_keys, jax_top)
from artgraph_tpu_torch.data.cache import wrap_with_cache
from artgraph_tpu_torch.data.loader import DataLoader, prepare_dataloader
from artgraph_tpu_torch.data.resident import (ResidentCapacityError,
                                              ResidentLoader)
from artgraph_tpu_torch.metrics import summarize, write_results
from artgraph_tpu_torch.parallel.mesh import current_mesh, spawn
from artgraph_tpu_torch.tracking import log_metric, track_params
from artgraph_tpu_torch.train import EarlyStopping, cross_entropy
from artgraph_tpu_torch.train.trainer import Trainer, accuracy_metrics


def get_base_arguments() -> argparse.ArgumentParser:
    """Shared argparse surface (ref: src/utils.py:17-28) plus the JAX CLIs'
    extras and --device."""
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
    parser.add_argument('-t', '--tracking', action='store_true',
                        help='If tracking or not with MLFlow.')
    parser.add_argument('--num_workers', type=int, default=6,
                        help='Host data-loader worker threads.')
    parser.add_argument('--data_parallel', type=int, default=0,
                        help='Devices on the data mesh axis (0 = single device).')
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
    parser.add_argument('--init_checkpoint', type=str, default=None,
                        help='Warm-start from a .pt checkpoint: a full '
                             'reference checkpoint of this model, or a '
                             'trunk-only file (raw torchvision resnet50 / '
                             'timm ViT state_dict — the pretrained weights '
                             'the reference fine-tunes from). Matching '
                             'subtrees are imported; everything else stays '
                             'freshly initialized.')
    parser.add_argument('--resume', type=str, default=None,
                        help='Checkpoint directory for crash recovery: the '
                             'full train state (params+opt_state+BN stats+'
                             'rng+epoch+early-stop state) is saved there '
                             'after every epoch, and training continues '
                             'from it when the directory holds one. The '
                             'reference has no resume (save-only best '
                             'checkpoints).')
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


def is_rank0() -> bool:
    """True outside a data mesh and on its rank 0: the process that prints
    and writes files."""
    mesh = current_mesh()
    return mesh is None or mesh.rank == 0


def needs_launch(args) -> bool:
    """--data_parallel N > 0 in a process that is not a rank yet."""
    return getattr(args, "data_parallel", 0) > 0 and current_mesh() is None


def launch_ranks(args, main: Callable, argv):
    """Run main(argv) in args.data_parallel spawned ranks (NCCL on
    `cuda:rank`, or gloo on the CPU) and return rank 0's result. Refuses
    more ranks than visible CUDA devices and a --batch they do not
    divide."""
    n = args.data_parallel
    device = torch.device(args.device)
    if device.type == "cuda":
        have = torch.cuda.device_count()
        if n > have:
            raise ValueError(f"--data_parallel {n}: mesh {n}x1 != {have} "
                             f"visible CUDA devices")
    batch = getattr(args, "batch", None)
    if batch is not None and batch % n:
        raise ValueError(f"--batch {batch} is not divisible by "
                         f"--data_parallel {n}")
    module = main.__module__
    if module == "__main__":      # python -m artgraph_tpu_torch.cli.<name>
        module = sys.modules["__main__"].__spec__.name
    argv = list(sys.argv[1:] if argv is None else argv)
    return spawn(_rank_cli, n, "nccl" if device.type == "cuda" else "gloo",
                 args=(module, argv), device=device, timeout=float("inf"))


def _rank_cli(mesh, module: str, argv: list):
    """One rank of a CLI: its main(argv), printing on rank 0 only."""
    import contextlib
    import importlib

    main = importlib.import_module(module).main
    if mesh.rank == 0:
        return main(argv)
    with open(os.devnull, "w") as devnull, \
            contextlib.redirect_stdout(devnull):
        return main(argv)


def make_mesh(args):
    """This rank's mesh under --data_parallel N (the spawned ranks' group),
    None for the one-process path."""
    if not getattr(args, "data_parallel", 0):
        return None
    mesh = current_mesh()
    if mesh is None or mesh.size != args.data_parallel:
        raise RuntimeError(f"--data_parallel {args.data_parallel}: no mesh "
                           f"of that size; the CLI starts its ranks itself "
                           f"(launch_ranks)")
    return mesh


def make_loaders(datasets: Dict, batch_size: int, num_workers: int,
                 seed: int = config.GLOBAL_SEED, cache_dir: str = None,
                 resident: bool = False, epoch_scan: bool = True,
                 device: str | torch.device = "cuda", mesh=None):
    """Reference loader kwargs (ref: train_baseline.py:23-25): shuffled,
    no drop_last; the last batch padded with a mask.

    `cache_dir` routes every split's images through the decoded cache.
    `resident=True` keeps each split on `device` (data/resident.py); a
    split that exceeds the device-memory budget WARNS and keeps the host
    DataLoader, as the JAX package's capacity rule does: its batches still
    train on the device. Over a data mesh every loader serves this rank's
    block of each batch, and residency is sharded (each rank holds its own
    rows)."""
    if cache_dir:
        datasets = {name: wrap_with_cache(ds, cache_dir, name)
                    for name, ds in datasets.items()}
    host_kwargs = dict(batch_size=batch_size, shuffle=True, drop_last=False,
                       num_workers=num_workers, seed=seed, mesh=mesh)
    if not resident:
        return prepare_dataloader(datasets, **host_kwargs)
    loaders = {}
    for name, ds in datasets.items():
        try:
            loaders[name] = ResidentLoader(
                ds, batch_size=batch_size, shuffle=True, drop_last=False,
                seed=seed, epoch_scan=epoch_scan, device=device, mesh=mesh)
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
    """EarlyStopping's save_fn: the model as a reference .pt (rank 0's)."""
    if not is_rank0():
        return
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    save_reference_checkpoint(model, path)


def reload_state(trainer: Trainer, path: str) -> None:
    """Load the best checkpoint back into the trainer's model (strict); over
    a mesh every rank reads rank 0's file once it is written."""
    if trainer.mesh is not None:
        dist.barrier()
    sd = torch.load(path, map_location="cpu", weights_only=True)
    trainer.model.load_state_dict(sd, strict=True)


def apply_init_checkpoint(trainer: Trainer, model_name: str,
                          path: str) -> Tuple[list, list]:
    """--init_checkpoint: overlay a .pt checkpoint's matching tensors onto
    the trainer's freshly initialized model (the reference's pretrained
    fine-tuning, ref: models.py:51-53,97: torchvision/timm weights).

    The full reference layout of model_name first, then a trunk-only
    import (raw torchvision/timm, or another model sharing the trunk;
    import_trunk_state). A tensor of the model present in the file with the
    same shape is copied into the existing parameter or buffer in place,
    cast to its dtype, so a CUDA graph captured later sees the addresses the
    optimizer holds; everything else stays fresh. Only the tensors the JAX
    variables hold take part (no num_batches_tracked, no unused timm head),
    and the report names and counts them as the JAX package's does.
    Returns the (imported, fresh) state_dict keys, a fresh key whose shape
    differs from the file's with the two shapes after it."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    dest = trainer.model.state_dict()
    keys = jax_counterpart_keys(model_name, dest)
    if all(k in raw for k in keys):
        src, scope = raw, "full model"
    else:
        src, scope = import_trunk_state(model_name, raw), "trunk only"
    imported, fresh = [], []
    with torch.no_grad():
        for k in keys:
            d = dest[k]
            if k not in src:
                fresh.append(k)
            elif tuple(src[k].shape) != tuple(d.shape):
                fresh.append(f"{k} (shape {tuple(src[k].shape)} != "
                             f"{tuple(d.shape)})")
            else:
                d.copy_(src[k].to(d.dtype))
                imported.append(k)

    # counted as the JAX overlay counts: a module the file lacks entirely
    # is one entry, anything else one entry a tensor
    modules: Dict[str, list] = {}
    for k in keys:
        modules.setdefault(jax_top(model_name, k), []).append(k)
    absent = {m for m, ks in modules.items() if not any(k in src for k in ks)}
    n_fresh = len(absent) + sum(
        1 for k in fresh if jax_top(model_name, k.split(" ")[0]) not in absent)
    tops = lambda names: sorted({jax_top(model_name, n.split(" ")[0])
                                 for n in names})
    print(f"init_checkpoint {path}: {scope}; imported {len(imported)} "
          f"tensors ({', '.join(tops(imported))}); "
          f"fresh {n_fresh} ({', '.join(tops(fresh)) or 'none'})")
    return imported, fresh


def maybe_warm_start(args, trainer: Trainer, model_name: str) -> None:
    if getattr(args, "init_checkpoint", None):
        apply_init_checkpoint(trainer, model_name, args.init_checkpoint)


# --resume: one file holds the whole train state and the epoch it ends;
# meta.json beside it is a readable copy of the loop's scalars
RESUME_STATE, RESUME_META = "state.pt", "meta.json"


def _rng_state(device: torch.device) -> torch.Tensor:
    """The generator dropout draws from: the device's (seed and Philox
    offset on cuda), the CPU's default otherwise."""
    if device.type == "cuda":
        return torch.cuda.get_rng_state(device)
    return torch.get_rng_state()


def save_resume_payload(resume_dir: str, payload: dict, meta: dict) -> int:
    """The state file, then meta.json, each written to a tmp file and
    renamed (a crash mid-write, exactly the window --resume exists for,
    leaves the previous file whole). The state file carries the epoch that
    a restart reads, so the weights and their epoch cannot come from two
    different saves. Shared by the Trainer CLIs and the GNN trainer's own
    loop; returns the state file's size in bytes."""
    nbytes = save_state(os.path.join(resume_dir, RESUME_STATE), payload)
    meta_path = os.path.join(resume_dir, RESUME_META)
    with open(meta_path + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(meta_path + ".tmp", meta_path)
    return nbytes


def load_resume_payload(resume_dir: str) -> Optional[dict]:
    """The payload save_resume_payload wrote in resume_dir, or None when
    there is none yet (a first run)."""
    path = os.path.join(resume_dir, RESUME_STATE)
    return restore_checkpoint(path) if os.path.exists(path) else None


def save_resume_state(resume_dir: str, trainer: Trainer, epoch: int,
                      early_stop: EarlyStopping) -> int:
    """The full train state after `epoch` epochs: the model's parameters and
    BN buffers, the optimizer's state (Adam's moments and step), the host
    step, the dropout generator's state (every rank's, over a mesh: all
    ranks call this, rank 0 writes) and the early-stopping state. Returns
    the state file's size in bytes (0 on the other ranks)."""
    stop = {"best_loss": early_stop.best_loss, "wait": early_stop.wait,
            "stop": early_stop.stop}
    rng = _rng_state(trainer.device)
    if trainer.mesh is not None:
        states = [None] * trainer.mesh.size
        dist.all_gather_object(states, rng.cpu())
        rng = states
    if not is_rank0():
        return 0
    return save_resume_payload(resume_dir, {
        "epoch": epoch, "host_step": trainer.host_step,
        "model": trainer.model.state_dict(),
        "optimizer": trainer.optimizer.state_dict(),
        "rng": rng, "early_stop": stop,
    }, {"epoch": epoch, **stop})


def load_resume_state(resume_dir: str, trainer: Trainer,
                      early_stop: EarlyStopping, payload: dict) -> int:
    """Restore what save_resume_state saved into the trainer and early_stop;
    returns the epoch to continue from. The parameters and buffers are
    copied in place; the optimizer's state tensors are new ones on the
    parameters' device (fused capturable Adam's step there too), so graphs
    captured before would update the old ones and are dropped. Done before
    the first step, no graph exists yet."""
    trainer.model.load_state_dict(payload["model"], strict=True)
    trainer.optimizer.load_state_dict(payload["optimizer"])
    trainer.graphs.clear()
    trainer.host_step = int(payload["host_step"])
    rng = payload["rng"]
    if trainer.mesh is not None:
        rng = rng[trainer.mesh.rank]
    if trainer.device.type == "cuda":
        torch.cuda.set_rng_state(rng, trainer.device)
    else:
        torch.set_rng_state(rng)
    for k, v in payload["early_stop"].items():
        setattr(early_stop, k, v)
    epoch = int(payload["epoch"])
    print(f"resumed from {resume_dir}: epoch {epoch}, "
          f"step {trainer.host_step}")
    return epoch


def run_epoch_loop(args, trainer: Trainer, loaders, early_stop: EarlyStopping,
                   train_fn: Callable[[int], object],
                   valid_fn: Callable[[int], object]) -> None:
    """The reference epoch loop: all --epochs run, train_fn(epoch) then
    valid_fn(epoch); early stopping only selects the saved checkpoint (ref:
    train_baseline.py:133-137). With --tracking the arguments are logged
    first. With --resume the full train state is saved after every epoch,
    with the seconds and bytes of the save printed, and a restart continues
    from the saved epoch: the restored generator gives the dropout masks,
    and each of `loaders` (the ones an epoch iterates once: train and
    valid) is advanced by the saved epoch to give the batch order, of an
    uninterrupted run. The test split's loader, which runs once after the
    loop, is not advanced."""
    if args.tracking:
        track_params(args)
    start_epoch = 0
    resume_dir = getattr(args, "resume", None)
    payload = load_resume_payload(resume_dir) if resume_dir else None
    if payload is not None:
        start_epoch = load_resume_state(resume_dir, trainer, early_stop,
                                        payload)
        for loader in loaders:
            loader._epoch += start_epoch
    for epoch in range(start_epoch, args.epochs):
        t0 = time.perf_counter()
        train_fn(epoch)
        valid_fn(epoch)
        if resume_dir:
            t1 = time.perf_counter()
            nbytes = save_resume_state(resume_dir, trainer, epoch + 1,
                                       early_stop)
            print(f"resume state saved to {resume_dir}: epoch {epoch + 1}, "
                  f"{nbytes} bytes in {time.perf_counter() - t1:.3f} s "
                  f"(the epoch took {t1 - t0:.3f} s)")


def log_test_metric(args, name: str, value: float) -> None:
    if args.tracking:
        log_metric(name, value)


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
    if results_dir and is_rank0():
        write_results(results_dir, summary, suffix=suffix)
    return summary["accuracy"]
