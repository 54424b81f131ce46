"""Training from a split held on the device: `Trainer.train_epoch` over the
`ResidentLoader` that `make_loaders(..., resident=True)` builds, one CUDA
graph replay a step with the batch gathered inside it.

Set-up: the seeded split and weights, the port's model and Trainer as
train_new_multimodal_multitask builds them, then the checked steps: three
one-batch epochs through the same `train_epoch` and loader, on three
distinct rows blocks the benchmark picks from the seed (the first captures
the step's graph), then the workload's warm-up epochs. The window: whole
epochs for `--seconds`.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import check, harness as h, inputs


class StagedResident:
    """The resident loader, its first epochs cut to one batch each: the
    index rows the benchmark picked, one per epoch; then the loader's own
    epochs."""

    def __init__(self, inner, rows: np.ndarray):
        self.inner = inner
        self.rows = rows
        self.staged = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __len__(self) -> int:
        return len(self.inner)

    def epoch_arrays(self):
        if self.staged >= len(self.rows):
            return self.inner.epoch_arrays()
        row = self.rows[self.staged]
        self.staged += 1
        dev = self.inner.device
        return (torch.as_tensor(row[None], dtype=torch.int64, device=dev),
                torch.ones((1, len(row)), dtype=torch.float32, device=dev),
                [len(row)])


def _setup(run: h.Run):
    from artgraph_tpu_torch.cli._common import make_loaders
    h.apply_env(run)
    wl = run.workload
    run.stamp("imports")
    split = inputs.make_split(run.cfg, wl["split_rows"], run.seed, run.device)
    run.stamp("split")
    weights = h.seeded_weights(run)
    model = h.program_model(run, weights, True)
    run.stamp("weights, model")
    trainer_seed = inputs.sub_seed(run.seed, "dropout")
    trainer = h.program_trainer(run, model, trainer_seed)
    run.stamp("trainer")
    inner = make_loaders({"train": inputs.ArraySplit(split)}, run.batch,
                         wl["num_workers"], resident=True, epoch_scan=True,
                         device=run.device)["train"]
    rows = inputs.rng(run.seed, "check_rows").choice(
        wl["split_rows"], (h.CHECK_STEPS, run.batch), replace=False)
    loader = StagedResident(inner, rows)
    run.stamp("resident loader")
    prog = h.program_step_readings(run, trainer, loader, weights)
    run.stamp("checked steps (graph captured)")
    batches = [inputs.ArraySplit(split).get_batch(r) for r in rows]
    return split, trainer, loader, trainer_seed, prog, batches


def run(run: h.Run) -> h.Outcome:
    split, trainer, loader, trainer_seed, prog, batches = _setup(run)
    for _ in range(run.workload["warmup_epochs"]):
        trainer.train_epoch(loader)
    run.stamp("warm-up epochs")
    tracer = h.Tracer(run)
    samples, start, end = h.train_window(run, trainer, loader, tracer)
    setup_s = start - run.t_start
    peak = h.memory_peak(run)
    del trainer, loader
    h.free_device(run)
    ref = h.reference_step_readings(run, batches, trainer_seed)
    tracer.read()
    return h.Outcome({"train_samples_per_s": samples / (end - start),
                      "setup_s": setup_s},
                     check.compare_train(prog, ref), samples, 0,
                     (start, end), peak, tracer)


def calibrate(run: h.Run) -> dict:
    """The checks' readings of the program, of the fp8 control and of the
    half-batch and altered-answer faults, each against the f32
    reference."""
    _, trainer, loader, trainer_seed, prog, batches = _setup(run)
    del trainer, loader
    h.free_device(run)
    ref = h.reference_step_readings(run, batches, trainer_seed)
    fp8 = h.reference_step_readings(run, batches, trainer_seed, "fp8")
    half = h.reference_step_readings(run, batches, trainer_seed,
                                     fault="half_batch")
    altered = h.reference_step_readings(run, batches, trainer_seed,
                                        fault="answer_altered")
    return {"program": check.compare_train(prog, ref),
            "control_fp8": check.compare_train(fp8, ref),
            "fault_half_batch": check.compare_train(half, ref),
            "fault_answer_altered": check.compare_train(altered, ref),
            "worst_grad_leaves": check.worst_leaves(prog.grad, ref.grad)}
