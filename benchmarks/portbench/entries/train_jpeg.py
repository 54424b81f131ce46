"""Training from JPEG files, as train_new_multimodal_multitask runs by
default: the CLI's `load_dataset_multitask_new_multimodal` over an ArtGraph
tree, `make_loaders`' host DataLoader (a thread pool decoding and resizing
on the host), and `Trainer.train_epoch`, which copies each batch to the
device one ahead of the step.

Set-up: a synthetic ArtGraph tree in a fresh directory under TMPDIR (the
manifest and label CSVs, the embedding tables, `jpeg_pool` seeded JPEGs
that the rows cycle over), the seeded weights, the port's model and
Trainer, then the checked steps: the first three batches of the loader's
first epoch, each trained as a one-batch epoch through `train_epoch`. The
window: whole epochs for `--seconds`. The check: every image of the
checked steps and of a seeded sample of the window's batches against the
plain PIL decode of the row's file, and the three steps against the plain
model trained on those decodes.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd

from portbench import check, harness as h, inputs, reference

SPLITS = ("train", "validation", "test")
EMB = {"style": ("emb_train_style.npy", "emb_valid_style.npy",
                 "emb_test_style.npy"),
       "genre": ("emb_train_genre.npy", "emb_valid_genre.npy",
                 "emb_test_genre.npy")}


class StagedHost:
    """The host loader as the Trainer's producer thread sees it: its first
    epochs cut to one batch each (the first batches of one epoch of the
    loader), then its own epochs, each `next()` timed as the span
    "loader_next", and the batches of the seeded serials copied aside."""

    def __init__(self, inner, run: h.Run, steps: int, sample: set):
        self.inner, self.run = inner, run
        self.steps, self.sample = steps, sample
        self.staged, self.serial = 0, 0
        self.checked: list = []          # the staged batches
        self.sampled: list = []          # the sampled window batches
        self._it = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __len__(self) -> int:
        return len(self.inner)

    def __iter__(self):
        if self.staged < self.steps:
            if self._it is None:
                self._it = iter(self.inner)
            batch = next(self._it)
            self.staged += 1
            self.checked.append(tuple(np.array(b) for b in batch))
            if self.staged == self.steps:
                self._it.close()
                self._it = None
            yield batch
            return
        it = iter(self.inner)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.run.span("loader_next", t0, time.perf_counter())
            if self.serial in self.sample:
                self.sampled.append(tuple(np.array(b) for b in batch))
            self.serial += 1
            yield batch


def _write_tree(run: h.Run, root: str) -> dict:
    """The ArtGraph tree under root: images/, dataset/<split>/... Returns
    the train split's tables (emb_style, emb_genre, labels) and the image
    file of each train row."""
    wl, cfg = run.workload, run.cfg
    names = inputs.write_jpegs(os.path.join(root, "images"), wl["jpeg_pool"],
                               run.seed, wl["jpeg_width"], wl["jpeg_height"],
                               wl["jpeg_quality"], wl["num_workers"])
    r = inputs.rng(run.seed, "tree")
    tables = {}
    for split, rows in zip(SPLITS, (wl["epoch_rows"], wl["eval_rows"],
                                    wl["eval_rows"])):
        base = os.path.join(root, "dataset", split)
        files = [names[i % len(names)] for i in range(rows)]
        labels = np.stack([r.integers(0, cfg["num_classes"][t], rows)
                           for t in ("style", "genre")], 1).astype(np.int32)
        for sub in ("mapping", "raw/node-label/artwork", "embeddings"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        pd.DataFrame({"idx": range(rows), "image": files}).to_csv(
            os.path.join(base, "mapping/artwork_entidx2name.csv"),
            header=False, index=False)
        for j, task in enumerate(("style", "genre")):
            pd.Series(labels[:, j]).to_csv(os.path.join(
                base, f"raw/node-label/artwork/node-label-{task}.csv"),
                header=False, index=False)
        embs = r.standard_normal((2, rows, cfg["emb_size"]),
                                 dtype=np.float32)
        k = SPLITS.index(split)
        np.save(os.path.join(base, "embeddings", EMB["style"][k]), embs[0])
        np.save(os.path.join(base, "embeddings", EMB["genre"][k]), embs[1])
        tables[split] = {"emb_style": embs[0], "emb_genre": embs[1],
                         "labels": labels, "files": files}
    return tables["train"]


def _setup(run: h.Run, root: str):
    from artgraph_tpu_torch.cli._common import make_loaders
    from artgraph_tpu_torch.data.factories import \
        load_dataset_multitask_new_multimodal
    h.apply_env(run)
    wl = run.workload
    run.stamp("imports")
    table = _write_tree(run, root)
    run.stamp("JPEG tree")
    train, _, _ = load_dataset_multitask_new_multimodal(
        base_dir=os.path.join(root, "dataset"),
        image_dir=os.path.join(root, "images"), emb_type="artwork",
        emb_train={t: EMB[t][0] for t in EMB},
        emb_valid={t: EMB[t][1] for t in EMB},
        emb_test={t: EMB[t][2] for t in EMB},
        transform_type=run.cfg["transform"])
    inner = make_loaders({"train": train}, run.batch, wl["num_workers"],
                         device=run.device)["train"]
    weights = h.seeded_weights(run)
    model = h.program_model(run, weights, True)
    run.stamp("datasets, weights, model")
    trainer_seed = inputs.sub_seed(run.seed, "dropout")
    trainer = h.program_trainer(run, model, trainer_seed)
    sample = set(inputs.rng(run.seed, "check_sample").choice(
        len(inner), wl["check_batches"], replace=False).tolist())
    loader = StagedHost(inner, run, h.CHECK_STEPS, sample)
    run.stamp("trainer")
    prog = h.program_step_readings(run, trainer, loader, weights)
    run.stamp("checked steps (graph captured)")
    return table, trainer, loader, trainer_seed, prog


def _reference_batches(run: h.Run, root: str, table: dict, batches: list
                       ) -> tuple[list, float]:
    """For the program's batches: the same rows with the images decoded by
    plain PIL and the embeddings and labels from the benchmark's tables,
    and the largest byte difference of the program's images from those
    decodes. A row is found by its style embedding, unique to it."""
    by_emb = {e.tobytes(): i for i, e in enumerate(table["emb_style"])}
    size = run.cfg["img_size"]
    out, diff = [], 0.0
    with ThreadPoolExecutor(max_workers=run.workload["num_workers"]) as pool:
        for images, emb_style, _, _, mask in batches:
            rows = [by_emb[e.tobytes()] for e in emb_style[mask > 0]]
            ref = np.stack(list(pool.map(
                lambda i: reference.decode_resize(os.path.join(
                    root, "images", table["files"][i]), size), rows)))
            diff = max(diff, check.compare_bytes(images[:len(rows)],
                                                 ref)["decode_diff"])
            out.append((ref, table["emb_style"][rows],
                        table["emb_genre"][rows], table["labels"][rows]))
    return out, diff


def run(run: h.Run) -> h.Outcome:
    root = tempfile.mkdtemp(prefix="portbench-")
    try:
        table, trainer, loader, trainer_seed, prog = _setup(run, root)
        tracer = h.Tracer(run)
        samples, start, end = h.train_window(run, trainer, loader, tracer)
        setup_s = start - run.t_start
        peak = h.memory_peak(run)
        checked, sampled = loader.checked, loader.sampled
        del trainer, loader
        h.free_device(run)
        batches, diff = _reference_batches(run, root, table,
                                           checked + sampled)
        ref = h.reference_step_readings(run, batches, trainer_seed)
        tracer.read()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    numbers = {"decode_diff": diff, **check.compare_train(prog, ref)}
    return h.Outcome({"jpeg_train_img_per_s": samples / (end - start),
                      "setup_s": setup_s},
                     numbers, samples, 0, (start, end), peak, tracer)


def calibrate(run: h.Run) -> dict:
    """The checks' readings of the program, of the fp8 control and of the
    half-batch and altered-answer faults, each against the f32 reference
    on the plain decodes."""
    root = tempfile.mkdtemp(prefix="portbench-")
    try:
        table, trainer, loader, trainer_seed, prog = _setup(run, root)
        checked = loader.checked
        del trainer, loader
        h.free_device(run)
        batches, diff = _reference_batches(run, root, table, checked)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ref = h.reference_step_readings(run, batches, trainer_seed)
    fp8 = h.reference_step_readings(run, batches, trainer_seed, "fp8")
    half = h.reference_step_readings(run, batches, trainer_seed,
                                     fault="half_batch")
    altered = h.reference_step_readings(run, batches, trainer_seed,
                                        fault="answer_altered")
    return {"program": {"decode_diff": diff,
                        **check.compare_train(prog, ref)},
            "control_fp8": check.compare_train(fp8, ref),
            "fault_half_batch": check.compare_train(half, ref),
            "fault_answer_altered": check.compare_train(altered, ref),
            "worst_grad_leaves": check.worst_leaves(prog.grad, ref.grad)}
